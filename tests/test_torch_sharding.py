"""The port's device mesh (``bulklmm_tpu_torch/parallel/sharding.py``) on
an 8-position CPU mesh, ``make_mesh(devices=["cpu"] * 8, marker_shards=2)``
(4 trait shards x 2 marker shards), against the port's single-device
engines and the JAX package's sharded engines on its 8 virtual CPU devices
(tests/conftest.py), fed the same numpy inputs; the mirror of
tests/test_sharding.py.

Bars:

- against the port's ``bulkscan`` / ``bulkscan_perms`` / ``scan``: 1e-9
  (float64 products over other column blocks), grid h2 equal. Every trait
  shard fits its own traits' null h2 once, and a trait's h2 must not depend
  on its shard beyond rounding: the batched Brent's likelihoods round with the
  width of the batch (on ``bxd_like`` trait 2's h2, at the 0 boundary, is
  9e-16 in a batch of 16 traits and 0 in one of 4 or 1), and an interior
  optimum then stops elsewhere inside Brent's window. So a Brent fit's h2
  is held to that window (2.8e-8, test_torch_bulkperm.py) and the scan
  that moves with it to 1e-6, the JAX package's bar for its own sharded
  null-exact scan (tests/test_sharding.py:35-37);
- against the JAX package: test_torch_bulkscan.py's EXACT64 bar (1e-9),
  test_torch_nullexact.py's for a null-exact scan (1e-6: Brent stops
  anywhere inside its window), test_torch_bulkperm.py's for the maxima
  (1e-9), the JAX package's shuffle indices passed as ``perm_idx=``;
- ``calc_kinship_sharded`` over 2 gloo processes against ``calc_kinship``:
  1e-10.

Run as a script, the file is the worker of the kinship test (one process
of the group).
"""

import importlib
import os
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from bulklmm_tpu import parallel as jpar
from bulklmm_tpu.ops.bulkperm import permutation_indices as jax_permutation_indices
from bulklmm_tpu.ops.lowrank import LowRankKinship
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch import parallel as tpar
from bulklmm_tpu_torch.kernels import build
from bulklmm_tpu_torch.models import tiles

torch.set_num_threads(1)

EQ = 1e-9
JAX_BAR = {"null-grid": 1e-9, "alt-grid": 1e-9, "null-exact": 1e-6}
NPERMS, SEED = 24, 7
H2_WINDOW = 2 * 1.4e-8  # a Brent h2 between batches of other widths (module docstring)
BRENT_L = 1e-6  # a scan at such an h2


def _np(x):
    return x.detach().cpu().double().numpy() if torch.is_tensor(x) else np.asarray(x, np.float64)


def _diff(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.fixture(scope="module")
def mesh():
    return tpar.make_mesh(devices=["cpu"] * 8, marker_shards=2)


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(8, marker_shards=2)


@pytest.fixture(scope="module")
def lowrank(bxd_like):
    lam, U = np.linalg.eigh(bxd_like["K"])
    return LowRankKinship(U=U[:, -20:], lam=lam[-20:])


def _jidx(n, nperms, seed):
    return np.asarray(jax_permutation_indices(n, nperms, seed))


_JAX = {}


def _jax(key, fn, *args, **kw):
    """Each JAX sharded call compiles for its shapes: computed once."""
    if key not in _JAX:
        _JAX[key] = fn(*args, **kw)
    return _JAX[key]


def test_mesh_shape_and_guards(mesh, monkeypatch):
    assert mesh.shape == {"traits": 4, "markers": 2}
    assert len(mesh.tiles()) == 8 and mesh.first == torch.device("cpu")
    assert tpar.make_mesh(3, devices=["cpu"] * 8).shape == {"traits": 3, "markers": 1}
    with pytest.raises(ValueError, match="must divide"):
        tpar.make_mesh(devices=["cpu"] * 8, marker_shards=3)
    # no card: the mesh never picks the CPU by itself
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r'devices=\["cpu"\]'):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match=r'devices=\["cpu"\]'):
        tpar.make_global_mesh()


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_sharded_matches_single_device_and_jax(bxd_like, mesh, jmesh, method):
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    port = tpar.bulkscan_sharded(Y, G, K, mesh=mesh, method=method, precision=bt.EXACT64)
    one = bt.bulkscan(Y, G, K, method=method, precision=bt.EXACT64, device="cpu")
    ref = _jax(("scan", method), jpar.bulkscan_sharded, Y, G, K, mesh=jmesh, method=method,
               precision=jcfg.EXACT64)
    assert tuple(port.L.shape) == (bxd_like["p"], bxd_like["m"])
    assert port.L.device == mesh.first
    exact = method == "null-exact"
    assert _diff(port.L, one.L) < (BRENT_L if exact else EQ)
    assert _diff(port.L, ref.L) < JAX_BAR[method]
    if method == "alt-grid":
        assert _diff(port.h2_panel, one.h2_panel) == 0.0
    else:
        assert _diff(port.h2_null_list, one.h2_null_list) <= (H2_WINDOW if exact else 0.0)
        assert _diff(port.h2_null_list, ref.h2_null_list) <= (JAX_BAR[method] if exact else 0.0)


def test_sharded_uneven_traits_and_markers(bxd_like, mesh, jmesh):
    """13 traits on 4 trait shards and 51 markers on 2 marker shards:
    padded, the padding sliced off; with effects, p-values and trait
    blocks of 5 (2 columns a shard)."""
    Y, G, K = bxd_like["Y"][:, :13], bxd_like["G"][:, :51], bxd_like["K"]
    kw = dict(output_effects=True, output_pvals=True)
    port = tpar.bulkscan_sharded(Y, G, K, mesh=mesh, trait_chunk=5, precision=bt.EXACT64,
                                 **kw)
    one = bt.bulkscan(Y, G, K, precision=bt.EXACT64, device="cpu", **kw)
    ref = _jax("uneven", jpar.bulkscan_sharded, Y, G, K, mesh=jmesh, trait_chunk=5,
               precision=jcfg.EXACT64, **kw)
    assert tuple(port.L.shape) == (51, 13)
    for f in ("L", "beta_mat", "beta_se_mat", "log10Pvals_mat"):
        assert _diff(getattr(port, f), getattr(one, f)) < EQ, f
        assert _diff(getattr(port, f), getattr(ref, f)) < JAX_BAR["null-grid"], f
    assert port.chisq_df == 1


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_sharded_trait_chunk_matches_unchunked(bxd_like, mesh, method):
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    a = tpar.bulkscan_sharded(Y, G, K, mesh=mesh, method=method, trait_chunk=7,
                              precision=bt.EXACT64)
    b = tpar.bulkscan_sharded(Y, G, K, mesh=mesh, method=method, precision=bt.EXACT64)
    assert _diff(a.L, b.L) < 1e-12
    h2 = "h2_panel" if method == "alt-grid" else "h2_null_list"
    assert _diff(getattr(a, h2), getattr(b, h2)) < 1e-12


def test_sharded_weights_covariates_and_masks(bxd_like, mesh, jmesh):
    rng = np.random.default_rng(9)
    n = bxd_like["n"]
    Y, G, K = bxd_like["Y"][:, :6], bxd_like["G"], bxd_like["K"]
    w = rng.uniform(0.5, 2.0, n)
    port = tpar.bulkscan_sharded(Y, G, K, mesh=mesh, weights=w, output_pvals=True,
                                 precision=bt.EXACT64)
    one = bt.bulkscan(Y, G, K, weights=w, output_pvals=True, precision=bt.EXACT64,
                      device="cpu")
    ref = _jax("weights", jpar.bulkscan_sharded, Y, G, K, mesh=jmesh, weights=w,
               output_pvals=True, precision=jcfg.EXACT64)
    for f in ("L", "log10Pvals_mat"):
        assert _diff(getattr(port, f), getattr(one, f)) < EQ
        assert _diff(getattr(port, f), getattr(ref, f)) < EQ
    covar = rng.normal(size=(n, 2))
    a = tpar.bulkscan_sharded(Y, G, K, covar, mesh=mesh, precision=bt.EXACT64)
    b = bt.bulkscan(Y, G, K, covar, precision=bt.EXACT64, device="cpu")
    assert _diff(a.L, b.L) < EQ
    Yn = Y.copy()
    Yn[3, 1] = Yn[7, 4] = np.nan
    a = tpar.bulkscan_sharded(Yn, G, K, mesh=mesh, missing="mask", precision=bt.EXACT64)
    b = bt.bulkscan(Yn, G, K, missing="mask", precision=bt.EXACT64, device="cpu")
    assert _diff(a.L, b.L) < EQ and _diff(a.h2_null_list, b.h2_null_list) == 0.0
    with pytest.raises(ValueError, match="missing"):
        tpar.bulkscan_sharded(Yn, G, K, mesh=mesh, precision=bt.EXACT64)


@pytest.mark.parametrize("method", ["null-grid", "null-exact", "alt-grid"])
def test_sharded_lowrank_matches_single_device(bxd_like, mesh, lowrank, method):
    Y, G = bxd_like["Y"], bxd_like["G"]
    effects = method != "alt-grid"
    a = tpar.bulkscan_sharded(Y, G, lowrank, mesh=mesh, method=method, trait_chunk=5,
                              output_effects=effects, precision=bt.EXACT64)
    b = bt.bulkscan(Y, G, lowrank, method=method, output_effects=effects,
                    precision=bt.EXACT64, device="cpu")
    fields = ["L"] + (["h2_null_list", "beta_mat", "beta_se_mat"] if effects
                      else ["h2_panel"])
    bar = BRENT_L if method == "null-exact" else EQ
    for f in fields:
        assert _diff(getattr(a, f), getattr(b, f)) < bar, f


def test_sharded_lowrank_matches_jax(bxd_like, mesh, jmesh, lowrank):
    Y, G = bxd_like["Y"], bxd_like["G"]
    a = tpar.bulkscan_sharded(Y, G, lowrank, mesh=mesh, precision=bt.EXACT64)
    ref = _jax("lowrank", jpar.bulkscan_sharded, Y, G, lowrank, mesh=jmesh,
               precision=jcfg.EXACT64)
    assert _diff(a.L, ref.L) < EQ
    assert _diff(a.h2_null_list, ref.h2_null_list) == 0.0


def test_distinct_devices_run_on_threads(bxd_like, monkeypatch):
    """"cpu" and "cpu:0" are two devices to the mesh: every tile run takes
    one host thread a device, two threads, with the same results. Each row
    and each column of the mesh holds both, so that the null fits (once a
    trait shard, on the first device of its row) run on two threads too."""
    mesh2 = tpar.make_mesh(devices=["cpu", "cpu:0", "cpu:0", "cpu"], marker_shards=2)
    assert len(set(mesh2.flat)) == 2
    calls = []
    run_tiles = tiles._run_tiles

    def spy(tiles, work):
        seen = set()
        calls.append(seen)
        return run_tiles(tiles, lambda *t: (seen.add((t[2], threading.get_ident())), work(*t))[1])

    monkeypatch.setattr(tiles, "_run_tiles", spy)
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    a = tpar.bulkscan_sharded(Y, G, K, mesh=mesh2, method="null-exact", precision=bt.EXACT64)
    p = tpar.bulkscan_perms_sharded(Y, G, K, mesh=mesh2, nperms=8, precision=bt.EXACT64)
    assert calls and all(len(seen) == 2 and len({tid for _, tid in seen}) == 2
                         for seen in calls)
    b = bt.bulkscan(Y, G, K, method="null-exact", precision=bt.EXACT64, device="cpu")
    q = bt.bulkscan_perms(Y, G, K, nperms=8, precision=bt.EXACT64, device="cpu")
    assert _diff(a.L, b.L) < BRENT_L and _diff(p.maxlods, q.maxlods) < EQ


@pytest.mark.parametrize("lowrank_kin", [False, True], ids=["dense", "rank-k"])
def test_null_exact_fits_once_a_trait_shard(bxd_like, mesh, lowrank, monkeypatch, lowrank_kin):
    """The null h2 does not depend on the markers: on the 4 x 2 mesh
    null-exact runs one Brent fit a trait shard (4), not one a tile (8), and
    every marker shard of a trait shard scans at those h2s."""
    # the modules whose names the two fits are called by
    mod, name = (("bulklmm_tpu_torch.ops.lowrank", "fit_h2_lowrank") if lowrank_kin
                 else ("bulklmm_tpu_torch.models.bulkscan", "fit_h2_traits"))
    mod = importlib.import_module(mod)
    fits = []
    brent = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: (fits.append(1), brent(*a, **k))[1])
    Y, G = bxd_like["Y"], bxd_like["G"]
    K = lowrank if lowrank_kin else bxd_like["K"]
    a = tpar.bulkscan_sharded(Y, G, K, mesh=mesh, method="null-exact", precision=bt.EXACT64)
    assert len(fits) == mesh.shape["traits"]
    b = bt.bulkscan(Y, G, K, method="null-exact", precision=bt.EXACT64, device="cpu")
    assert _diff(a.h2_null_list, b.h2_null_list) < H2_WINDOW and _diff(a.L, b.L) < BRENT_L


def test_first_kernel_build_is_shared_by_the_mesh_threads(tmp_path, monkeypatch):
    """The tiles of distinct devices launch their first kernels from host
    threads of their own, all at once: one build serves every thread, and
    none of them writes over another's objects."""
    lib = tmp_path / "libkernels.so"
    builds = []

    def fake_build(path):
        builds.append(threading.get_ident())
        time.sleep(0.2)  # long enough for every thread to ask meanwhile
        path.write_bytes(b"")

    monkeypatch.setattr(build, "library_path", lambda: lib)
    monkeypatch.setattr(build, "_build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", str)
    build.load_library.cache_clear()
    start = threading.Barrier(4)

    def first_launch(_):
        start.wait()
        return build.load_library()

    try:
        with ThreadPoolExecutor(4) as ex:
            got = list(ex.map(first_launch, range(4)))
    finally:
        build.load_library.cache_clear()
    assert len(builds) == 1 and got == [str(lib)] * 4


def test_perms_sharded_matches_single_device_and_jax(bxd_like, mesh, jmesh):
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    idx = _jidx(bxd_like["n"], NPERMS, SEED)
    port = tpar.bulkscan_perms_sharded(Y, G, K, mesh=mesh, nperms=NPERMS, perm_idx=idx,
                                       precision=bt.EXACT64)
    one = bt.bulkscan_perms(Y, G, K, nperms=NPERMS, perm_idx=idx, precision=bt.EXACT64,
                            device="cpu")
    ref = _jax("perms", jpar.bulkscan_perms_sharded, Y, G, K, mesh=jmesh, nperms=NPERMS,
               rndseed=SEED, precision=jcfg.EXACT64)
    assert tuple(port.maxlods.shape) == (bxd_like["m"], NPERMS + 1)
    for f in ("maxlods", "h2_null_list", "sigma2_e_list", "log10_adj_pvals"):
        assert _diff(getattr(port, f), getattr(one, f)) < EQ, f
        assert _diff(getattr(port, f), getattr(ref, f)) < EQ, f


def test_perms_sharded_chunks_engines_and_null_exact(bxd_like, mesh):
    """7 traits in blocks of 3 (padded to the 4 trait shards), 5
    permutations a device step, the kernel's plain version on every
    tile (``engine="pallas", interpret=True``), and null-exact."""
    Y, G, K = bxd_like["Y"][:, :7], bxd_like["G"], bxd_like["K"]
    for kw, engine in ((dict(trait_chunk=3, perm_chunk=5), {}),
                       (dict(trait_chunk=3), dict(engine="pallas", interpret=True))):
        one = bt.bulkscan_perms(Y, G, K, nperms=23, rndseed=3, precision=bt.EXACT64,
                                device="cpu", **engine)
        a = tpar.bulkscan_perms_sharded(Y, G, K, mesh=mesh, nperms=23, rndseed=3,
                                        precision=bt.EXACT64, **kw, **engine)
        assert _diff(a.maxlods, one.maxlods) < EQ, engine
    a = tpar.bulkscan_perms_sharded(Y, G, K, mesh=mesh, nperms=23, method="null-exact",
                                    precision=bt.EXACT64)
    b = bt.bulkscan_perms(Y, G, K, nperms=23, method="null-exact", precision=bt.EXACT64,
                          device="cpu")
    assert _diff(a.maxlods, b.maxlods) < BRENT_L
    assert _diff(a.h2_null_list, b.h2_null_list) <= H2_WINDOW


def test_perms_sharded_lowrank(bxd_like, mesh, jmesh, lowrank):
    Y, G = bxd_like["Y"][:, :10], bxd_like["G"]
    idx = _jidx(bxd_like["n"], 99, 5)
    a = tpar.bulkscan_perms_sharded(Y, G, lowrank, mesh=mesh, nperms=99, perm_idx=idx,
                                    trait_chunk=3, perm_chunk=32, precision=bt.EXACT64)
    b = bt.bulkscan_perms(Y, G, lowrank, nperms=99, perm_idx=idx, precision=bt.EXACT64,
                          device="cpu")
    ref = _jax("lowrank-perms", jpar.bulkscan_perms_sharded, Y, G, lowrank, mesh=jmesh,
               nperms=99, rndseed=5, precision=jcfg.EXACT64)
    assert _diff(a.maxlods, b.maxlods) < EQ and _diff(a.maxlods, ref.maxlods) < EQ
    assert _diff(a.h2_null_list, b.h2_null_list) == 0.0
    with pytest.raises(ValueError, match="pallas"):
        tpar.bulkscan_perms_sharded(Y, G, lowrank, mesh=mesh, nperms=9, engine="pallas")


def test_perms_sharded_checkpoint_and_masks(bxd_like, mesh, tmp_path):
    import json

    Y, G, K = bxd_like["Y"][:, :9], bxd_like["G"], bxd_like["K"]
    kw = dict(mesh=mesh, nperms=15, trait_chunk=4, precision=bt.EXACT64)
    a = tpar.bulkscan_perms_sharded(Y, G, K, checkpoint=tmp_path / "ck", **kw)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    assert meta["rank"] == "full-sharded" and meta["trait_chunk"] == 4
    assert len(list((tmp_path / "ck").glob("maxlods_*.npy"))) == 3
    (tmp_path / "ck" / "maxlods_4_8.npy").unlink()
    b = tpar.bulkscan_perms_sharded(Y, G, K, checkpoint=tmp_path / "ck", **kw)
    assert torch.equal(a.maxlods, b.maxlods)
    Yn = Y.copy()
    Yn[2, 5] = np.nan
    c = tpar.bulkscan_perms_sharded(Yn, G, K, missing="mask", **kw)
    d = bt.bulkscan_perms(Yn, G, K, missing="mask", nperms=15, precision=bt.EXACT64,
                          device="cpu")
    assert _diff(c.maxlods, d.maxlods) < EQ


def test_scan_perms_sharded(bxd_like, mesh, jmesh):
    y, G, K = bxd_like["Y"][:, 0], bxd_like["G"], bxd_like["K"]
    idx = _jidx(bxd_like["n"], 199, 11)
    port = tpar.scan_perms_sharded(y, G, K, mesh=mesh, nperms=199, perm_idx=idx,
                                   precision=bt.EXACT64)
    one = bt.scan(y, G, K, permutation_test=True, nperms=199, perm_idx=idx,
                  prior_variance=1.0, precision=bt.EXACT64, device="cpu")
    ref = _jax("scan-perms", jpar.scan_perms_sharded, y, G, K, mesh=jmesh, nperms=199,
               rndseed=11, precision=jcfg.EXACT64)
    assert tuple(port.L_perms.shape) == (bxd_like["p"], 199)
    for f in ("lod", "L_perms"):
        assert _diff(getattr(port, f), getattr(one, f)) < EQ
        assert _diff(getattr(port, f), getattr(ref, f)) < EQ
    assert float(port.h2_null) == float(one.h2_null) == float(ref.h2_null)
    # 10 permutations do not divide the 4 trait shards: zero columns
    # pad them, and the draws are the unsharded scan's
    a = tpar.scan_perms_sharded(y, G, K, mesh=mesh, nperms=10, rndseed=4,
                                precision=bt.EXACT64)
    b = bt.scan(y, G, K, permutation_test=True, nperms=10, rndseed=4, prior_variance=1.0,
                precision=bt.EXACT64, device="cpu")
    assert _diff(a.L_perms, b.L_perms) < EQ


def test_shard_rotated_and_single_process_pod(bxd_like, mesh):
    n = bxd_like["n"]
    y0 = torch.randn(n, 13, dtype=torch.float64)
    X0 = torch.randn(n, 52, dtype=torch.float64)
    lam = torch.rand(n, dtype=torch.float64)
    y0s, X0ms, C0s, lams, m, p = tpar.shard_rotated(y0, X0, lam, 1, mesh)
    assert (m, p) == (13, 51)
    t = (3, 1, mesh.devices[3][1])
    assert torch.equal(y0s[t][:, :1], y0[:, 12:13]) and not y0s[t][:, 1:].any()
    assert torch.equal(X0ms[t][:, :25], X0[:, 27:52]) and torch.equal(C0s[t], X0[:, :1])
    assert torch.equal(lams[t], lam)
    assert tpar.init_distributed() == 0
    sl = tpar.local_trait_slice(100)
    assert (sl.start, sl.stop) == (0, 100)


def test_calc_kinship_sharded_two_processes(bxd_like, tmp_path):
    """Two gloo processes, each with half of the markers: each ends
    with the whole kinship."""
    G = bxd_like["G"]
    np.save(tmp_path / "G.npy", G)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    procs = [subprocess.Popen([sys.executable, __file__, f"127.0.0.1:{port}", str(r),
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for r, proc in enumerate(procs):
        out = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0, f"process {r}:\n{out[-2000:]}"
    ref = bt.calc_kinship(G, bt.EXACT64, device="cpu")
    for r in range(2):
        assert _diff(np.load(tmp_path / f"K{r}.npy"), ref) < 1e-10


def _kinship_worker(coordinator, rank, outdir):
    """One process of the kinship test: markers [rank::2] of G."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops.kinship import calc_kinship_sharded

    bt.parallel.init_distributed(coordinator, 2, rank)
    G = np.load(Path(outdir) / "G.npy")
    cols = np.array_split(np.arange(G.shape[1]), 2)[rank]
    K = calc_kinship_sharded(G[:, cols], precision=bt.EXACT64, device="cpu")
    np.save(Path(outdir) / f"K{rank}.npy", K.numpy())


if __name__ == "__main__":
    _kinship_worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
