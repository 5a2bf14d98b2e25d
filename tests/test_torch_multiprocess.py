"""The port's pod path (``bulklmm_tpu_torch/parallel/distributed.py``) in
real processes: N processes join one gloo group over ``tcp://127.0.0.1``,
each contributes two CPU positions to the global mesh and feeds only its
own trait block, writes its own shard file, and the merged shards must
equal the single-process port to 1e-9 (EXACT64, float64); the mirror of
tests/test_multiprocess.py. Also the CLI's ``podscan`` in two processes
with ``merge-shards``.

Run as a script, the file is one process of a pod:

    test_torch_multiprocess.py <coordinator> <nproc> <pid> <data.npz> <outdir> <mode>
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
GRID = np.arange(0.0, 0.91, 0.1)
EQ = 1e-9

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _synth(seed=11, n=40, p=30, m=10):
    rng = np.random.default_rng(seed)
    G = rng.uniform(0, 1, (n, p))
    X = G - 0.5
    K = 2.0 * X @ X.T / p + 0.5
    np.fill_diagonal(K, 1.0)
    Y = rng.normal(size=(n, m))
    Y[:, 0] += 0.8 * (G[:, 3] - G[:, 3].mean())
    return Y, G, K


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(nproc, data, outdir, mode, coord=None):
    coord = coord or f"127.0.0.1:{_free_port()}"
    return [
        subprocess.Popen(
            [sys.executable, __file__, coord, str(nproc), str(i), str(data), str(outdir), mode],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nproc)
    ]


def _finish(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    return outs


def _run_pod(nproc, mode, tmp_path, m=10):
    Y, G, K = _synth(m=m)
    data = tmp_path / "data.npz"
    np.savez(data, Y=Y, G=G, K=K)
    outdir = tmp_path / "shards"
    _finish(_launch(nproc, data, outdir, mode))
    return Y, G, K, outdir


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_bulkscan_matches_single_process(nproc, tmp_path):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.parallel import merge_shards

    Y, G, K, outdir = _run_pod(nproc, "null-grid", tmp_path)
    assert len(list(outdir.glob("lod_shard_*.npz"))) == nproc
    merged = merge_shards(outdir)
    single = bt.bulkscan(Y, G, K, h2_grid=GRID, precision=bt.EXACT64, device="cpu")
    assert merged.shape == tuple(single.L.shape)
    assert float(np.max(np.abs(merged - single.L.numpy()))) < EQ


def test_multiprocess_alt_grid_matches_single_process(tmp_path):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.parallel import merge_shards

    Y, G, K, outdir = _run_pod(2, "alt-grid", tmp_path, m=6)
    single = bt.bulkscan(Y, G, K, method="alt-grid", h2_grid=GRID, precision=bt.EXACT64,
                         device="cpu")
    assert float(np.max(np.abs(merge_shards(outdir) - single.L.numpy()))) < EQ
    z = np.load(outdir / "lod_shard_00001.npz")
    assert z["h2"].shape == (G.shape[1], int(z["trait_hi"]) - int(z["trait_lo"]))


def test_multiprocess_lowrank_matches_single_process(tmp_path):
    """Rank-k pod path: every process builds the same rank-16 factors from
    the replicated K; merged shards equal the single-process rank-k scan."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.parallel import merge_shards

    Y, G, K, outdir = _run_pod(2, "lowrank:null-grid", tmp_path, m=8)
    lr = bt.kinship_lowrank_exact(K, 16, dtype=torch.float64, device="cpu")
    single = bt.bulkscan(Y, G, lr, h2_grid=GRID, precision=bt.EXACT64, device="cpu")
    assert float(np.max(np.abs(merge_shards(outdir) - single.L.numpy()))) < EQ


def test_multiprocess_perms_matches_single_process(tmp_path):
    """Pod permutation maxima: each process sweeps its trait block with the
    same seeded shuffles; merged, they equal the single-process sweep."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.parallel import merge_perm_shards

    Y, G, K, outdir = _run_pod(2, "perms", tmp_path)
    ref = bt.bulkscan_perms(Y, G, K, nperms=24, rndseed=7, precision=bt.EXACT64, device="cpu")
    merged = merge_perm_shards(outdir)
    assert merged.shape == (10, 25)
    assert float(np.max(np.abs(merged - ref.maxlods.numpy()))) < EQ


def test_pod_kill_and_resume(tmp_path):
    """One process of a checkpointed 2-process permutation pod is killed
    mid-sweep; the restarted pod resumes from the per-process checkpoints,
    and the merged shards equal the uninterrupted single-process sweep."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.parallel import merge_perm_shards

    Y, G, K = _synth(m=16, n=60)
    data = tmp_path / "data.npz"
    np.savez(data, Y=Y, G=G, K=K)
    ck = tmp_path / "ck"
    procs = _launch(2, data, tmp_path / "killed", f"perms_ckpt:{ck}")
    victim = ck / "p1"
    deadline = time.time() + 120
    try:
        while time.time() < deadline and procs[1].poll() is None:
            if list(victim.glob("maxlods_*.npy")):
                os.kill(procs[1].pid, signal.SIGKILL)
                break
            time.sleep(0.01)
    finally:
        for p in procs:
            try:
                p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
    assert list(victim.glob("maxlods_*.npy")), "process 1 wrote no chunk before it ended"
    _finish(_launch(2, data, tmp_path / "resumed", f"perms_ckpt:{ck}"))
    merged = merge_perm_shards(tmp_path / "resumed")
    ref = bt.bulkscan_perms(Y, G, K, nperms=499, rndseed=7, trait_chunk=1,
                            precision=bt.EXACT64, device="cpu")
    assert float(np.max(np.abs(merged - ref.maxlods.numpy()))) < EQ


def test_pod_geometry_and_guards():
    """Single-process geometry, the shard files' tiling check and the
    distributed scan's weight guards (one process, the same path)."""
    import warnings

    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch import parallel as tpar
    from bulklmm_tpu_torch.parallel import distributed

    sl = tpar.local_trait_slice(17)
    assert (sl.start, sl.stop) == (0, 17)
    mesh = tpar.make_global_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"traits": 4, "markers": 1} and mesh.ranks == ((0,),) * 4
    assert tpar.local_trait_slice(10, mesh) == slice(0, 10)
    with pytest.raises(ValueError, match="do not cover"):
        distributed._check_shards_tile(
            [{"trait_lo": 0, "trait_hi": 3}, {"trait_lo": 5, "trait_hi": 9}], 9, "d")
    with pytest.raises(ValueError, match="together"):
        tpar.init_distributed("127.0.0.1:1", 2)
    Y, G, K = _synth(n=30, p=12, m=8)
    with pytest.raises(ValueError, match="cached decomposition"):
        tpar.bulkscan_distributed(Y, G, bt.decompose_kinship(K, device="cpu"),
                                  weights=np.ones(30), mesh=mesh)
    with pytest.raises(ValueError, match="expected 8 local trait columns"):
        tpar.bulkscan_distributed(Y[:, :5], G, K, m_total=8, mesh=mesh)
    w = np.ones(30)
    w[0] = -1.0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = tpar.bulkscan_distributed(Y, G, K, weights=w, mesh=mesh, precision=bt.EXACT64)
        assert any("not positive" in str(r.message) for r in rec)
    one = bt.bulkscan(Y, G, K, weights=w, precision=bt.EXACT64, device="cpu")
    assert float(np.max(np.abs(res.L_local - one.L.numpy()))) < EQ
    assert tuple(res.L.shape) == (12, 8) and (res.trait_lo, res.trait_hi) == (0, 8)


def test_cli_podscan_two_processes(tmp_path):
    """``python -m bulklmm_tpu_torch podscan --device cpu`` in two processes,
    then ``merge-shards``: the merged LODs and permutation maxima equal the
    CLI's single-process bulkscan of the same files."""
    Y, G, _ = _synth(n=30, p=20, m=6)
    np.savez(tmp_path / "geno.npz", geno=G)
    np.savez(tmp_path / "pheno.npz", pheno=Y)
    base = [sys.executable, "-m", "bulklmm_tpu_torch"]
    files = ["--geno", str(tmp_path / "geno.npz"), "--pheno", str(tmp_path / "pheno.npz"),
             "--precision", "exact64", "--device", "cpu"]

    def pod(extra, shards):
        coord = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(
            base + ["podscan", *files, "--coordinator", coord, "--nproc", "2", "--pid", str(i),
                    "--save-shards", str(shards), "-o", str(tmp_path / "pod.npz"), *extra],
            env=_env(), cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for i in range(2)]
        outs = _finish(procs)
        return [json.loads(o.strip().splitlines()[-1]) for o in outs]

    metas = pod([], tmp_path / "lod")
    assert sorted(tuple(mt["traits"]) for mt in metas) == [(0, 3), (3, 6)]
    metas = pod(["--nperms", "16", "--seed", "3"], tmp_path / "perm")
    assert {Path(mt["shard"]).name for mt in metas} == {"perm_shard_00000.npz",
                                                        "perm_shard_00001.npz"}
    for args in (["merge-shards", "--shards-dir", str(tmp_path / "lod"),
                  "-o", str(tmp_path / "L.npz")],
                 ["merge-shards", "--perms", "--shards-dir", str(tmp_path / "perm"),
                  "-o", str(tmp_path / "P.npz")],
                 ["bulkscan", *files, "--nperms", "16", "--seed", "3",
                  "-o", str(tmp_path / "one.npz")]):
        r = subprocess.run(base + args, env=_env(), cwd=tmp_path, capture_output=True,
                           text=True, timeout=180)
        assert r.returncode == 0, r.stderr[-2000:]
    one = np.load(tmp_path / "one.npz")
    assert float(np.max(np.abs(np.load(tmp_path / "L.npz")["L"] - one["L"]))) < EQ
    P = np.load(tmp_path / "P.npz")
    assert float(np.max(np.abs(P["perm_maxlods"] - one["perm_maxlods"]))) < EQ
    assert np.allclose(P["thresholds"], one["thresholds"], rtol=0, atol=EQ)


#: one process of a pod that joins, takes the census and returns; its first
#: exit handler (the last to run) reports whether the group outlived the
#: teardown that init_distributed registered
_JOIN_AND_RETURN = """
import atexit, sys
import torch.distributed as dist
from bulklmm_tpu_torch import parallel as tpar
atexit.register(lambda: print("group alive at exit:", dist.is_initialized(), flush=True))
assert tpar.init_distributed(sys.argv[1], 2, int(sys.argv[2])) == int(sys.argv[2])
assert tpar.make_global_mesh(devices=["cpu"]).shape["traits"] == 2
"""


def test_pod_process_exits_cleanly():
    """Processes that called ``init_distributed`` and return normally exit
    with code 0, with no ``terminate called`` on stderr, and their group is
    destroyed by the interpreter's exit (three pods of two side by side)."""
    procs = []
    for _ in range(3):
        coord = f"127.0.0.1:{_free_port()}"
        procs += [subprocess.Popen([sys.executable, "-c", _JOIN_AND_RETURN, coord, str(r)],
                                   env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "terminate called" not in err, err[-2000:]
        assert "group alive at exit: False" in out, out + err[-2000:]


def _worker(coord, nproc, pid, data_path, outdir, mode):
    """One process of a pod: join the group, take this process's trait
    block, write its shard."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch import parallel as tpar

    tpar.init_distributed(coord, int(nproc), int(pid))
    d = np.load(data_path)
    Y, G, K = d["Y"], d["G"], d["K"]
    mesh = tpar.make_global_mesh(devices=["cpu", "cpu"])
    assert mesh.shape["traits"] == 2 * int(nproc)
    sl = tpar.local_trait_slice(Y.shape[1], mesh)
    kw = dict(m_total=Y.shape[1], mesh=mesh, save_dir=outdir, precision=bt.EXACT64)
    if mode.startswith("perms_ckpt:"):
        # many small trait chunks widen the window of the kill
        tpar.bulkscan_perms_distributed(Y[:, sl], G, K, nperms=499, rndseed=7, trait_chunk=1,
                                        checkpoint=f"{mode.split(':', 1)[1]}/p{pid}", **kw)
    elif mode == "perms":
        res, lo, hi = tpar.bulkscan_perms_distributed(Y[:, sl], G, K, nperms=24, rndseed=7,
                                                      **kw)
        assert (lo, hi) == (sl.start, sl.stop) and tuple(res.maxlods.shape) == (hi - lo, 25)
    else:
        if mode.startswith("lowrank:"):
            # exact eigenpairs: every process builds the same factors
            mode = mode.split(":", 1)[1]
            K = bt.kinship_lowrank_exact(K, 16, dtype=torch.float64, device="cpu")
        res = tpar.bulkscan_distributed(Y[:, sl], G, K, method=mode, h2_grid=GRID, **kw)
        assert (res.trait_lo, res.trait_hi) == (sl.start, sl.stop)
        assert res.L_local.shape == (G.shape[1], sl.stop - sl.start)
    print(f"process {pid}: traits [{sl.start}, {sl.stop})")


if __name__ == "__main__":
    _worker(*sys.argv[1:7])
