"""Leave-one-chromosome-out scans of the port (``models/loco.py``) against
the JAX package's on the CPU, fed the same numpy inputs: ``bxd_like`` with
tests/test_loco.py's split into 4 chromosomes of unequal size.

Bars:

- ``loco_kinship``: 1e-12 against both packages' kinship of the subset
  panel (float64 products in another order).
- EXACT64 ``bulkscan_loco``: 1e-8 for null-grid and alt-grid, with effects
  and p-values, and the per-chromosome null h2 equal.
- Fits by Brent (null-exact ``bulkscan_loco``, the host null fit of
  ``scan_loco``): h2 and everything that moves with it at
  test_torch_nullexact.py's EXACT64 bars (1e-6). The two packages' leave-out
  kinships differ in their last bits (float64 products summed in another
  order), and Brent stops anywhere inside its window (3e-8) where the
  likelihood is flat, so h2 is not bit-equal as it is on one kinship.
- BALANCED: 1e-4 (test_torch_bulkscan.py's preset bar).
- ``bulkscan_perms_loco`` with the JAX package's shuffle indices (its
  ``permutation_indices`` patched in for the port's at the same seeds):
  1e-9 column by column, grid h2 equal; ``scan_loco``'s permutation
  columns at the Brent bars above; the alt assumption at
  test_torch_scan.py's alt bars (LOD 1e-6, h2 3e-7).
- The port's composition, each chromosome's rows against its own
  ``bulkscan`` on the kinship ``loco_kinship`` gives it: 1e-12 (the same
  operations).
- ``lowrank_k = n`` against the dense LOCO scan: 5e-4 (tests/test_loco.py).
"""

import hashlib

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops.bulkperm import permutation_indices as jax_permutation_indices
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.models import bulkperm as tbulkperm
from bulklmm_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

BAR = {"null-grid": 1e-8, "alt-grid": 1e-8, "null-exact": 1e-6}
BRENT_BAR = 1e-6
CHROMS = ["1", "2", "3", "X"]
NPERMS, SEED = 16, 5


@pytest.fixture(scope="module")
def loco_data(bxd_like):
    p = bxd_like["p"]
    chrom = np.repeat(CHROMS, [40, 32, 28, p - 100])
    return bxd_like["G"], bxd_like["Y"][:, :4], chrom


def _jax_indices(n, nperms, rndseed, original=True):
    idx = jax_permutation_indices(n, nperms, int(rndseed), original=original)
    return torch.from_numpy(np.array(idx, dtype=np.int64))


@pytest.fixture
def jax_shuffles(monkeypatch):
    """The JAX package's shuffle indices in place of the port's draws, at
    the seeds the port asks for (``scan`` draws through ``ops/stats.py``,
    ``bulkscan_perms`` through ``models/bulkperm.py``)."""
    monkeypatch.setattr(tstats, "permutation_indices", _jax_indices)
    monkeypatch.setattr(tbulkperm, "permutation_indices", _jax_indices)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _diff(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


_JAX = {}


def _jax(key, fn, *args, **kw):
    """Each JAX LOCO call compiles per chromosome shape: computed once."""
    if key not in _JAX:
        _JAX[key] = fn(*args, **kw)
    return _JAX[key]


def test_loco_kinship_equals_subset_kinships(loco_data):
    G, _, chrom = loco_data
    port = bt.loco_kinship(G, chrom, bt.EXACT64, device="cpu")
    ref = bl.loco_kinship(G, chrom, jcfg.EXACT64)
    assert list(port) == list(ref) == CHROMS
    for c in CHROMS:
        assert port[c].dtype == torch.float64
        assert _diff(port[c], ref[c]) < 1e-12, c
        assert _diff(port[c], bt.calc_kinship(G[:, chrom != c], bt.EXACT64, device="cpu")) < 1e-12
        assert _diff(port[c], bl.calc_kinship(G[:, chrom != c])) < 1e-12


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_bulkscan_loco_exact64_matches_jax(loco_data, method):
    G, Y, chrom = loco_data
    kw = dict(method=method, output_pvals=True, output_effects=method != "alt-grid")
    ref = _jax(("bulkscan", method), bl.bulkscan_loco, Y, G, chrom, precision=jcfg.EXACT64, **kw)
    port = bt.bulkscan_loco(Y, G, chrom, precision=bt.EXACT64, device="cpu", **kw)
    assert port.L.dtype == torch.float64 and tuple(port.L.shape) == (G.shape[1], 4)
    fields = ["L", "log10Pvals_mat"] + (["beta_mat", "beta_se_mat"] if kw["output_effects"] else [])
    for f in fields:
        assert _diff(getattr(port, f), getattr(ref, f)) < BAR[method], f
    assert port.chisq_df == ref.chisq_df == 1
    assert list(port.h2_null_by_chrom) == list(ref.h2_null_by_chrom) == CHROMS
    h2_bar = BRENT_BAR if method == "null-exact" else 0.0
    for c in CHROMS:
        assert _diff(port.h2_null_by_chrom[c], ref.h2_null_by_chrom[c]) <= h2_bar, c


@pytest.mark.parametrize("method", ["null-grid", "alt-grid"])
def test_bulkscan_loco_balanced_matches_jax(loco_data, method):
    G, Y, chrom = loco_data
    ref = _jax(("balanced", method), bl.bulkscan_loco, Y, G, chrom, method=method,
               precision=jcfg.BALANCED)
    port = bt.bulkscan_loco(Y, G, chrom, method=method, precision=bt.BALANCED, device="cpu")
    assert port.L.dtype == torch.float64
    assert _diff(port.L, ref.L) < 1e-4
    for c in CHROMS:
        assert np.array_equal(_np(port.h2_null_by_chrom[c]), _np(ref.h2_null_by_chrom[c])), c


@pytest.mark.parametrize("method", ["null-grid", "null-exact"])
def test_bulkscan_loco_is_its_per_chromosome_scans(loco_data, method):
    G, Y, chrom = loco_data
    res = bt.bulkscan_loco(Y, G, chrom, method=method, output_effects=True,
                           precision=bt.EXACT64, device="cpu")
    Ks = bt.loco_kinship(G, chrom, bt.EXACT64, device="cpu")
    for c in CHROMS:
        mask = chrom == c
        one = bt.bulkscan(Y, G[:, mask], Ks[c], method=method, output_effects=True,
                          precision=bt.EXACT64, device="cpu")
        assert _diff(res.L[mask], one.L) < 1e-12, c
        assert _diff(res.beta_mat[mask], one.beta_mat) < 1e-12, c
        assert _diff(res.h2_null_by_chrom[c], one.h2_null_list) < 1e-12, c


def test_scan_loco_null_perms_match_jax(loco_data, jax_shuffles):
    G, Y, chrom = loco_data
    y = Y[:, 0]
    kw = dict(permutation_test=True, nperms=NPERMS, rndseed=SEED, output_pvals=True,
              output_effects=True)
    ref = _jax("scan-perms", bl.scan_loco, y, G, chrom, precision=jcfg.EXACT64, **kw)
    port = bt.scan_loco(y, G, chrom, precision=bt.EXACT64, device="cpu", **kw)
    assert port.lod.dtype == torch.float64
    for f in ("lod", "L_perms", "log10pvals", "log10Pvals_perms", "beta", "beta_se"):
        assert _diff(getattr(port, f), getattr(ref, f)) < BRENT_BAR, f
    assert list(port.h2_null_by_chrom) == list(ref.h2_null_by_chrom) == CHROMS
    for by in ("h2_null_by_chrom", "sigma2_by_chrom"):
        a, b = getattr(port, by), getattr(ref, by)
        assert max(abs(a[c] - b[c]) for c in CHROMS) < BRENT_BAR, by
    assert abs(float(port.h2_null) - float(ref.h2_null)) < BRENT_BAR
    assert abs(float(port.sigma2_e) - float(ref.sigma2_e)) < BRENT_BAR


def test_scan_loco_share_shuffles_and_seeds(loco_data, jax_shuffles):
    """Chromosome i permutes with rndseed + i, or rndseed on every chromosome
    under ``share_shuffles``; each against the port's own ``scan``."""
    G, Y, chrom = loco_data
    y = Y[:, 2]
    kw = dict(permutation_test=True, nperms=NPERMS, rndseed=SEED, precision=bt.EXACT64,
              device="cpu")
    own = bt.scan_loco(y, G, chrom, **kw)
    shared = bt.scan_loco(y, G, chrom, share_shuffles=True, **kw)
    Ks = bt.loco_kinship(G, chrom, bt.EXACT64, device="cpu")
    for i, c in enumerate(CHROMS[:2]):
        mask = chrom == c
        for res, seed in ((own, SEED + i), (shared, SEED)):
            one = bt.scan(y, G[:, mask], Ks[c], permutation_test=True, nperms=NPERMS,
                          rndseed=seed, precision=bt.EXACT64, device="cpu")
            assert _diff(res.L_perms[mask], one.L_perms) < 1e-12, (c, seed)


def test_scan_loco_alt_matches_jax(loco_data):
    G, Y, chrom = loco_data
    y = Y[:, 1]
    ref = _jax("scan-alt", bl.scan_loco, y, G, chrom, assumption="alt", precision=jcfg.EXACT64)
    port = bt.scan_loco(y, G, chrom, assumption="alt", precision=bt.EXACT64, device="cpu")
    assert _diff(port.lod, ref.lod) < 1e-6
    assert _diff(port.h2_each_marker, ref.h2_each_marker) < 3e-7
    assert max(abs(port.h2_null_by_chrom[c] - ref.h2_null_by_chrom[c]) for c in CHROMS) < BRENT_BAR


@pytest.mark.parametrize("share", [False, True])
def test_bulkscan_perms_loco_matches_jax(loco_data, jax_shuffles, share):
    G, Y, chrom = loco_data
    kw = dict(nperms=19, rndseed=3, share_shuffles=share)
    ref = _jax(("perms", share), bl.bulkscan_perms_loco, Y, G, chrom, precision=jcfg.EXACT64,
               **kw)
    port = bt.bulkscan_perms_loco(Y, G, chrom, precision=bt.EXACT64, device="cpu", **kw)
    assert tuple(port.maxlods.shape) == (4, 20)
    for j in range(port.maxlods.shape[1]):
        assert _diff(port.maxlods[:, j], ref.maxlods[:, j]) < 1e-9, j
    assert _diff(port.log10_adj_pvals, ref.log10_adj_pvals) < 1e-12
    assert _diff(port.h2_null_list, ref.h2_null_list) < 1e-12
    assert _diff(port.sigma2_e_list, ref.sigma2_e_list) < 1e-9
    assert list(port.h2_null_by_chrom) == CHROMS
    for c in CHROMS:
        assert _diff(port.h2_null_by_chrom[c], ref.h2_null_by_chrom[c]) == 0.0, c
    assert port.nperms == ref.nperms and port.original == ref.original


def test_bulkscan_perms_loco_is_max_of_chromosomes(loco_data):
    """The stitched maxima are the elementwise max of the per-chromosome
    sweeps at seeds rndseed + i, against the leave-out kinships."""
    G, Y, chrom = loco_data
    res = bt.bulkscan_perms_loco(Y, G, chrom, nperms=12, rndseed=7, precision=bt.EXACT64,
                                 device="cpu")
    Ks = bt.loco_kinship(G, chrom, bt.EXACT64, device="cpu")
    parts = [bt.bulkscan_perms(Y, G[:, chrom == c], Ks[c], nperms=12, rndseed=7 + i,
                               precision=bt.EXACT64, device="cpu").maxlods
             for i, c in enumerate(CHROMS)]
    assert torch.equal(res.maxlods, torch.stack(parts).amax(0))


def test_loco_missing_mask_matches_jax(loco_data):
    G, Y, chrom = loco_data
    Y = Y.copy()
    Y[2:6, 1] = np.nan
    Y[[0, 9], 3] = np.nan
    ref = _jax("masked", bl.bulkscan_loco, Y, G, chrom, missing="mask", precision=jcfg.EXACT64)
    port = bt.bulkscan_loco(Y, G, chrom, missing="mask", precision=bt.EXACT64, device="cpu")
    assert _diff(port.L, ref.L) < 1e-8
    for c in CHROMS:
        assert np.array_equal(_np(port.h2_null_by_chrom[c]), _np(ref.h2_null_by_chrom[c])), c
    with pytest.raises(ValueError, match="missing='mask'"):
        bt.bulkscan_loco(Y, G, chrom, device="cpu")
    # one trait: the complete-case rows, as scan_loco of the subset
    y = Y[:, 1]
    ok = np.isfinite(y)
    a = bt.scan_loco(y, G, chrom, missing="mask", precision=bt.EXACT64, device="cpu")
    b = bt.scan_loco(y[ok], G[ok], chrom, precision=bt.EXACT64, device="cpu")
    assert torch.equal(a.lod, b.lod)
    # a masked permutation sweep stitches its groups' LOCO maxima
    pm = bt.bulkscan_perms_loco(Y, G, chrom, missing="mask", nperms=8, precision=bt.EXACT64,
                                device="cpu")
    assert tuple(pm.maxlods.shape) == (4, 9) and bool(torch.isfinite(pm.maxlods).all())
    assert list(pm.h2_null_by_chrom) == CHROMS


def test_loco_checkpoint_subdirectories_and_resume(loco_data, tmp_path):
    G, Y, chrom = loco_data
    kw = dict(nperms=10, rndseed=2, precision=bt.EXACT64, device="cpu", trait_chunk=2)
    first = bt.bulkscan_perms_loco(Y, G, chrom, checkpoint=tmp_path, **kw)
    names = sorted(d.name for d in tmp_path.iterdir())
    assert names == sorted(f"chr_{c}_{hashlib.sha1(c.encode()).hexdigest()[:8]}" for c in CHROMS)
    for d in tmp_path.iterdir():
        assert len(list(d.glob("maxlods_*.npy"))) == 2
    again = bt.bulkscan_perms_loco(Y, G, chrom, checkpoint=tmp_path, **kw)
    assert torch.equal(first.maxlods, again.maxlods)
    # a label that sanitizes like another keeps its own directory
    odd = np.where(chrom == "X", "1:A", chrom)
    bt.bulkscan_perms_loco(Y, G, odd, checkpoint=tmp_path / "odd", **kw)
    tag = hashlib.sha1(b"1:A").hexdigest()[:8]
    assert (tmp_path / "odd" / f"chr_1_A_{tag}").is_dir()


def test_loco_lowrank_engine_matches_dense(loco_data):
    G, Y, chrom = loco_data
    n = G.shape[0]
    dense = bt.bulkscan_loco(Y, G, chrom, precision=bt.EXACT64, device="cpu")
    low = bt.bulkscan_loco(Y, G, chrom, lowrank_k=n, precision=bt.EXACT64, device="cpu")
    assert _diff(dense.L, low.L) < 5e-4
    perms = bt.bulkscan_perms_loco(Y, G, chrom, lowrank_k=n, nperms=8, precision=bt.EXACT64,
                                   device="cpu")
    assert tuple(perms.maxlods.shape) == (4, 9) and bool(torch.isfinite(perms.maxlods).all())
    sl = bt.scan_loco(Y[:, 0], G, chrom, lowrank_k=n, precision=bt.EXACT64, device="cpu")
    sd = bt.scan_loco(Y[:, 0], G, chrom, precision=bt.EXACT64, device="cpu")
    assert _diff(sl.lod, sd.lod) < 5e-4


def test_loco_guards(loco_data):
    G, Y, chrom = loco_data
    with pytest.raises(ValueError, match="2 chromosomes"):
        bt.bulkscan_loco(Y, G, np.repeat("1", G.shape[1]), device="cpu")
    with pytest.raises(ValueError, match="one entry per marker"):
        bt.bulkscan_loco(Y, G, chrom[:-3], device="cpu")
    with pytest.raises(ValueError, match="profile_ll"):
        bt.scan_loco(Y[:, 0], G, chrom, profile_ll=True, device="cpu")
    # a mesh's calls run from its first device: another device= is refused
    mesh = bt.parallel.make_mesh(devices=["cpu:0"] * 2)
    for fn in (bt.bulkscan_loco, bt.bulkscan_perms_loco):
        with pytest.raises(ValueError, match="disagree"):
            fn(Y, G, chrom, mesh=mesh, device="cpu")


@pytest.mark.parametrize("method", ["null-grid", "alt-grid"])
def test_loco_on_a_mesh_is_its_sharded_calls(loco_data, method):
    """``mesh=``: one sharded call a chromosome (4 trait x 2 marker shards
    on the CPU), each chromosome's rows those of ``bulkscan_sharded`` on its
    leave-out kinship (1e-12, the same operations) and within 1e-9 of the
    single-device LOCO call; the permutation maxima likewise."""
    G, Y, chrom = loco_data
    mesh = bt.parallel.make_mesh(devices=["cpu"] * 8, marker_shards=2)
    res = bt.bulkscan_loco(Y, G, chrom, method=method, mesh=mesh, precision=bt.EXACT64)
    one = bt.bulkscan_loco(Y, G, chrom, method=method, precision=bt.EXACT64, device="cpu")
    assert _diff(res.L, one.L) < 1e-9
    Ks = bt.loco_kinship(G, chrom, bt.EXACT64, device="cpu")
    for c in CHROMS:
        mask = chrom == c
        sh = bt.parallel.bulkscan_sharded(Y, G[:, mask], Ks[c], method=method, mesh=mesh,
                                          precision=bt.EXACT64)
        assert _diff(res.L[mask], sh.L) < 1e-12, c
    if method == "null-grid":
        kw = dict(nperms=NPERMS, precision=bt.EXACT64)
        pm = bt.bulkscan_perms_loco(Y, G, chrom, mesh=mesh, trait_chunk=3, **kw)
        po = bt.bulkscan_perms_loco(Y, G, chrom, device="cpu", **kw)
        assert _diff(pm.maxlods, po.maxlods) < 1e-9
        assert _diff(pm.log10_adj_pvals, po.log10_adj_pvals) < 1e-9


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no CUDA exists")
def test_loco_numpy_without_device_raises(loco_data):
    G, Y, chrom = loco_data
    for call in (lambda: bt.loco_kinship(G, chrom), lambda: bt.bulkscan_loco(Y, G, chrom),
                 lambda: bt.scan_loco(Y[:, 0], G, chrom),
                 lambda: bt.bulkscan_perms_loco(Y, G, chrom, nperms=4)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
