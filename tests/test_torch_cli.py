"""The port's command line (``bulklmm_tpu_torch/cli.py``) against the JAX
package's (``bulklmm_tpu/cli.py``): both ``main``s called in this process on
the same CSV files, the port with ``--device cpu``, and their output files
compared; the argument errors; the device mesh (``--sharded``, on the
port's side a virtual mesh of the CPU, on the JAX package's its 8 virtual
devices), ``podscan`` as a pod of one process and ``merge-shards``; one
subprocess of ``python -m bulklmm_tpu_torch``.

Where a run permutes, the JAX package's shuffle indices are patched in for
the port's at the same seeds (tests/test_torch_loco.py). Bars: EXACT64
1e-8, with 1e-6 where an h2 comes from Brent (the null fit of ``scan``;
tests/test_torch_loco.py says why); BALANCED 1e-4 (test_torch_bulkscan.py's
preset bar); the rank-k engine at k = n, where both packages' randomized
factors are exact, 1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bulklmm_tpu import cli as jcli
from bulklmm_tpu.ops.bulkperm import permutation_indices as jax_permutation_indices
from bulklmm_tpu_torch import cli
from bulklmm_tpu_torch.models import bulkperm as tbulkperm
from bulklmm_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

N, P, M = 30, 40, 6
CHROM = ["1"] * 15 + ["2"] * 13 + ["X"] * 12


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    """tests/test_cli.py's CSV files (30 strains, 40 complement pairs, 6
    traits and a sex column) and a 3-chromosome marker map."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    G = rng.uniform(0, 1, (N, 2 * P))
    with open(d / "geno.csv", "w") as f:
        f.write("id," + ",".join(f"m{i}_{a}" for i in range(P) for a in "AB") + "\n")
        for i, row in enumerate(G):
            f.write(f"s{i}," + ",".join(map(str, row)) + "\n")
    Y = rng.normal(size=(N, M))
    with open(d / "pheno.csv", "w") as f:
        f.write("id," + ",".join(f"t{i}" for i in range(M)) + ",sex\n")
        for i, row in enumerate(Y):
            f.write(f"s{i}," + ",".join(map(str, row)) + ",1\n")
    with open(d / "gmap.csv", "w") as f:
        f.write("Locus,Chr,cM,Mb\n")
        for i, c in enumerate(CHROM):
            f.write(f"m{i},{c},{i * 1.0},{i * 0.5}\n")
    return d


def _jax_indices(n, nperms, rndseed, original=True):
    idx = jax_permutation_indices(n, nperms, int(rndseed), original=original)
    return torch.from_numpy(np.array(idx, dtype=np.int64))


@pytest.fixture
def jax_shuffles(monkeypatch):
    monkeypatch.setattr(tstats, "permutation_indices", _jax_indices)
    monkeypatch.setattr(tbulkperm, "permutation_indices", _jax_indices)


def _args(d, sub, out, *extra, pheno=True):
    a = [sub, "--geno", str(d / "geno.csv"), "--exclude-complements", "-o", str(d / out)]
    if pheno:
        a += ["--pheno", str(d / "pheno.csv")]
    return a + [str(x) for x in extra]


def _both(capsys, d, sub, *extra, pheno=True, ext=".npz"):
    """Run the JAX CLI and the port's on the same files; return their
    outputs (npz dicts, CSV arrays) and the last lines they printed, the
    output path in them replaced by OUT. "{pkg}" in an argument becomes
    "jax" or "port", so that each package writes its own checkpoints."""
    tag = "_".join(str(x).lstrip("-") for x in (sub,) + extra)[:80].replace("/", "")
    outs, lines = [], []
    for name, main, dev in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = f"{name}_{tag}{ext}"
        own = [str(x).replace("{pkg}", name) for x in extra]
        main(_args(d, sub, out, *own, *dev, pheno=pheno))
        lines.append(capsys.readouterr().out.strip().splitlines()[-1].replace(str(d / out), "OUT"))
        if ext == ".npz":
            z = np.load(d / out)
            outs.append({k: z[k] for k in z.files})
        else:
            outs.append(np.loadtxt(d / out, delimiter=","))
    return outs, lines


def _close(a, b, bar):
    for k in sorted(a):
        assert a[k].shape == b[k].shape, k
        assert np.max(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))) <= bar, k


def test_cli_kinship_matches_jax(csv, capsys):
    (ref, port), lines = _both(capsys, csv, "kinship", "--precision", "exact64", pheno=False,
                               ext=".csv")
    assert port.shape == (N, N) and np.allclose(np.diag(port), 1.0)
    assert np.max(np.abs(port - ref)) < 1e-12
    assert lines[0] == lines[1]
    # rank-k factors at k = n reproduce the kinship; a CSV output is refused
    cli.main(_args(csv, "kinship", "K_lr.npz", "--lowrank-k", N, "--precision", "exact64",
                   "--device", "cpu", pheno=False))
    z = np.load(csv / "K_lr.npz")
    assert z["U"].shape == (N, N) and z["lam"].shape == (N,)
    assert np.max(np.abs((z["U"] * z["lam"]) @ z["U"].T - port)) < 1e-8
    with pytest.raises(SystemExit, match=".npz"):
        cli.main(_args(csv, "kinship", "K_lr.csv", "--lowrank-k", 8, "--device", "cpu",
                       pheno=False))


def test_cli_scan_matches_jax(csv, capsys, jax_shuffles):
    (ref, port), lines = _both(capsys, csv, "scan", "--trait", 1, "--nperms", 24, "--seed", 3,
                               "--effects", "--pvals", "--precision", "exact64")
    _close(port, ref, 1e-6)
    mj, mp = json.loads(lines[0]), json.loads(lines[1])
    assert set(mp) == set(mj) == {"trait", "h2_null", "sigma2_e", "thresholds"}
    assert mp["trait"] == 1 and abs(mp["h2_null"] - mj["h2_null"]) < 1e-6
    for lvl in ("0.10", "0.05", "0.01"):
        assert abs(mp["thresholds"][lvl] - mj["thresholds"][lvl]) < 1e-6
    # CSV output: the columns side by side; the alt assumption
    (ref, port), _ = _both(capsys, csv, "scan", "--trait", 2, "--assumption", "alt",
                           "--precision", "exact64", ext=".csv")
    assert port.shape == (P,) and np.max(np.abs(port - ref)) < 1e-6


def test_cli_scan_loco_matches_jax(csv, capsys):
    (ref, port), lines = _both(capsys, csv, "scan", "--trait", 0, "--loco", "--gmap",
                               csv / "gmap.csv", "--precision", "exact64")
    _close(port, ref, 1e-6)
    mj, mp = json.loads(lines[0]), json.loads(lines[1])
    assert list(mp["h2_null_by_chrom"]) == list(mj["h2_null_by_chrom"]) == ["1", "2", "X"]
    for c, v in mj["h2_null_by_chrom"].items():
        assert abs(mp["h2_null_by_chrom"][c] - v) < 1e-6


def test_cli_bulkscan_loco_perms_effects_match_jax(csv, capsys, jax_shuffles):
    (ref, port), _ = _both(capsys, csv, "bulkscan", "--loco", "--gmap", csv / "gmap.csv",
                           "--nperms", 19, "--seed", 4, "--effects", "--pvals",
                           "--precision", "exact64")
    assert sorted(port) == sorted(ref) == sorted(
        ["L", "beta", "beta_se", "log10Pvals", "h2_null_chr1", "h2_null_chr2", "h2_null_chrX",
         "perm_maxlods", "thresholds", "log10_adj_pvals"])
    assert port["L"].shape == (P, M) and port["L"].dtype == ref["L"].dtype == np.float64
    assert port["perm_maxlods"].shape == (M, 20) and port["thresholds"].shape == (3, M)
    _close(port, ref, 1e-8)


@pytest.mark.parametrize("method", ["null-grid", "alt-grid"])
def test_cli_bulkscan_balanced_matches_jax(csv, capsys, method):
    (ref, port), lines = _both(capsys, csv, "bulkscan", "--method", method, "--trait-chunk", 4)
    assert sorted(port) == sorted(ref)
    _close(port, ref, 1e-4)
    assert lines[0] == lines[1]


def test_cli_bulkscan_lowrank_matches_jax(csv, capsys, jax_shuffles):
    (ref, port), _ = _both(capsys, csv, "bulkscan", "--lowrank-k", N, "--nperms", 8,
                           "--precision", "exact64")
    _close(port, ref, 1e-6)


def test_cli_kinship_reuse_matches_jax(csv, capsys):
    for name, main, dev in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        main(_args(csv, "kinship", f"K_{name}.csv", "--precision", "exact64", *dev, pheno=False))
        main(_args(csv, "bulkscan", f"reuse_{name}.npz", "--kinship", csv / f"K_{name}.csv",
                   "--precision", "exact64", *dev))
    capsys.readouterr()
    ref, port = (dict(np.load(csv / f"reuse_{name}.npz")) for name in ("jax", "port"))
    _close(port, ref, 1e-8)
    cli.main(_args(csv, "bulkscan", "fresh.npz", "--precision", "exact64", "--device", "cpu"))
    assert np.array_equal(np.load(csv / "fresh.npz")["L"], port["L"])
    # rank-k factors from a file, and a dense file factored at rank k = n
    dense, lods = ["--trait", 0, "--precision", "exact64", "--device", "cpu"], {}
    cli.main(_args(csv, "kinship", "K_n.npz", "--lowrank-k", N, *dense[2:], pheno=False))
    for name, extra in (("dense", []), ("factors", ["--kinship", csv / "K_n.npz"]),
                        ("refactored", ["--kinship", csv / "K_port.csv", "--lowrank-k", N])):
        cli.main(_args(csv, "scan", f"scan_{name}.npz", *dense, *extra))
        lods[name] = np.load(csv / f"scan_{name}.npz")["lod"]
    capsys.readouterr()
    for name in ("factors", "refactored"):
        assert np.max(np.abs(lods[name] - lods["dense"])) < 1e-6, name


def test_cli_bulkscan_stream_markers_match_jax(csv, capsys, jax_shuffles):
    (ref, port), _ = _both(capsys, csv, "bulkscan", "--stream-markers", 16, "--nperms", 8,
                           "--resume", csv / "stream_ck_{pkg}", "--checkpoint-every", 2,
                           "--precision", "exact64")
    _close(port, ref, 1e-8)


def test_cli_bulkscan_resume(csv, capsys, tmp_path):
    base = ["--nperms", 20, "--trait-chunk", 2, "--device", "cpu"]
    cli.main(_args(csv, "bulkscan", "a.npz", *base, "--resume", tmp_path / "ck"))
    assert len(list((tmp_path / "ck").glob("maxlods_*.npy"))) == 3
    cli.main(_args(csv, "bulkscan", "b.npz", *base, "--resume", tmp_path / "ck"))
    a, b = np.load(csv / "a.npz"), np.load(csv / "b.npz")
    assert np.array_equal(a["perm_maxlods"], b["perm_maxlods"])
    # with --loco the checkpoint fans out to one subdirectory a chromosome
    loco = ["--loco", "--gmap", csv / "gmap.csv"]
    cli.main(_args(csv, "bulkscan", "c.npz", *base, *loco, "--resume", tmp_path / "lk"))
    cli.main(_args(csv, "bulkscan", "d.npz", *base, *loco, "--resume", tmp_path / "lk"))
    assert sorted(p.name.split("_")[1] for p in (tmp_path / "lk").iterdir()) == ["1", "2", "X"]
    c, d = np.load(csv / "c.npz"), np.load(csv / "d.npz")
    assert np.array_equal(c["perm_maxlods"], d["perm_maxlods"])
    capsys.readouterr()


ERRORS = [
    (["bulkscan", "--out-csv"], ".npz"),
    (["bulkscan", "--loco"], "--gmap"),
    (["bulkscan", "--loco", "--gmap", "GMAP", "--stream-markers", 16], "stream"),
    (["bulkscan", "--nperms", 8, "--resume", "ck", "--checkpoint-every", 4], "stream-markers"),
    (["bulkscan", "--stream-markers", 16, "--checkpoint-every", 2], "nperms"),
    (["bulkscan", "--stream-markers", 16, "--checkpoint-every", 2, "--nperms", 8], "resume"),
    (["scan", "--loco", "--gmap", "GMAP", "--kinship", "K.csv"], "--kinship"),
    (["bulkscan", "--loco", "--gmap", "GMAP", "--kinship", "K.csv"], "--kinship"),
    (["podscan", "--coordinator", "127.0.0.1:1"], "together"),
    (["podscan", "--nproc", 2, "--pid", 0], "together"),
    (["podscan", "--loco", "--gmap", "GMAP"], "--loco/--gmap"),
]


@pytest.mark.parametrize("argv,message", ERRORS, ids=[f"{i}" for i in range(len(ERRORS))])
def test_cli_argument_errors(csv, argv, message):
    sub, extra = argv[0], [str(csv / "gmap.csv") if a == "GMAP" else a for a in argv[1:]]
    out = "x.csv" if "--out-csv" in extra else "x.npz"
    extra = [a for a in extra if a != "--out-csv"]
    with pytest.raises(SystemExit) as e:
        cli.main(_args(csv, sub, out, *extra, "--device", "cpu"))
    assert message in str(e.value.code)
    assert not (csv / out).exists()


def test_cli_merge_shards_refused_and_device_rule(csv, monkeypatch, tmp_path):
    # merge-shards refuses a directory without shards, and shards that do
    # not tile the traits (a process's file missing), as the JAX package's
    with pytest.raises(FileNotFoundError, match="lod_shard"):
        cli.main(["merge-shards", "--shards-dir", str(csv), "-o", str(csv / "m.npz")])
    for pid, (lo, hi) in enumerate([(0, 2), (4, 6)]):
        np.savez(tmp_path / f"lod_shard_{pid:05d}.npz", trait_lo=lo, trait_hi=hi,
                 lod=np.zeros((P, hi - lo)), h2=np.zeros(hi - lo))
    with pytest.raises(ValueError, match="do not cover"):
        cli.main(["merge-shards", "--shards-dir", str(tmp_path), "-o", str(csv / "m.npz")])
    assert not (csv / "m.npz").exists()
    # no card and no --device: exit naming --device cpu, never run unasked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(_args(csv, "bulkscan", "nodev.npz"))
    assert "--device cpu" in str(e.value.code)
    assert not (csv / "nodev.npz").exists()
    with pytest.raises(SystemExit) as e:
        cli.main(_args(csv, "bulkscan", "nodev.npz", "--sharded"))
    assert "--device cpu" in str(e.value.code)


SHARDED = {
    "sharded": ["--sharded", "--method", "null-exact", "--effects"],
    "marker-shards-perms": ["--sharded", "--marker-shards", 2, "--nperms", 12, "--seed", 2],
    "sharded-streamed": ["--sharded", "--marker-shards", 2, "--stream-markers", 16,
                         "--nperms", 8, "--seed", 1],
    "sharded-loco": ["--sharded", "--loco", "--gmap", "GMAP", "--nperms", 12],
}


@pytest.mark.parametrize("case", list(SHARDED))
def test_cli_bulkscan_sharded_matches_jax(csv, capsys, jax_shuffles, case):
    """``--sharded`` (with ``--marker-shards``, ``--nperms``,
    ``--stream-markers``, ``--loco``) against the JAX CLI's sharded runs:
    EXACT64 1e-8, null-exact 1e-6 (Brent's h2 moves inside its window)."""
    extra = [csv / "gmap.csv" if a == "GMAP" else a for a in SHARDED[case]]
    (ref, port), lines = _both(capsys, csv, "bulkscan", *extra, "--precision", "exact64")
    assert sorted(port) == sorted(ref)
    _close(port, ref, 1e-6 if "null-exact" in extra else 1e-8)
    assert lines[0] == lines[1]


def test_cli_podscan_and_merge_match_jax(csv, capsys, jax_shuffles, tmp_path):
    """``podscan`` as a pod of one process, its shard files merged by
    ``merge-shards``, LODs and permutation maxima, against the JAX CLI's."""
    merged = {}
    for name, main, dev in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        for kind, extra in (("lod", []), ("perm", ["--nperms", 16, "--seed", 3])):
            shards = tmp_path / f"{name}_{kind}"
            main(_args(csv, "podscan", f"pod_{name}.npz", "--precision", "exact64",
                       "--save-shards", shards, *extra, *dev))
            meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert meta["pid"] == 0 and meta["traits"] == [0, M]
            out = tmp_path / f"merged_{name}_{kind}.npz"
            main(["merge-shards", "--shards-dir", str(shards), "-o", str(out)]
                 + (["--perms"] if kind == "perm" else []))
            merged[name, kind] = dict(np.load(out))
    capsys.readouterr()
    for kind in ("lod", "perm"):
        _close(merged["port", kind], merged["jax", kind], 1e-8)
    assert merged["port", "perm"]["perm_maxlods"].shape == (M, 17)


def test_cli_module_subprocess(csv, capsys, tmp_path):
    """``python -m bulklmm_tpu_torch`` end to end: the LOCO permutation run in a
    process of its own equals the same run in this one, and that process
    never imports JAX (``-X importtime`` lists every module it imports)."""
    argv = ["--loco", "--gmap", csv / "gmap.csv", "--nperms", 12, "--seed", 2, "--device", "cpu"]
    cli.main(_args(csv, "bulkscan", "inproc.npz", *argv))
    capsys.readouterr()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "bulklmm_tpu_torch"]
        + _args(csv, "bulkscan", "sub.npz", *argv),
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("sub.npz")
    imported = {line.rsplit("|", 1)[-1].strip() for line in r.stderr.splitlines()
                if line.startswith("import time:")}
    assert "bulklmm_tpu_torch.cli" in imported
    assert not {m for m in imported if m.split(".")[0] in ("jax", "bulklmm_tpu")}
    a, b = np.load(csv / "inproc.npz"), np.load(csv / "sub.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.max(np.abs(a[k] - b[k])) < 1e-12, k
